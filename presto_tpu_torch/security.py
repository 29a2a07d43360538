"""Security: authentication + access control (a copy of
``presto_tpu/security.py``; the password authenticator is used by no
HTTP layer of the port yet).

Analog of the reference's security stack, reduced to the two
load-bearing contracts (server/security/ServerSecurityModule.java
authenticators; security/AccessControlManager.java + the file-based
system access control in lib/trino-plugin-toolkit):

- ``PasswordAuthenticator``: credential check at the HTTP boundary
  (the coordinator accepts Authorization: Basic when configured).
- ``AccessControl``: table-level authorization consulted by the
  planner at every table scan and by the dispatcher at submit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re


class AccessDeniedError(RuntimeError):
    """Reference AccessDeniedException analog."""


class AuthenticationError(RuntimeError):
    pass


# -- authentication ----------------------------------------------------------


class PasswordAuthenticator:
    def authenticate(self, user: str, password: str) -> None:
        raise NotImplementedError


class FileBasedPasswordAuthenticator(PasswordAuthenticator):
    """user -> sha256(password) map (the password-file authenticator,
    plugin/trino-password-authenticators)."""

    def __init__(self, users: dict[str, str]):
        self.users = dict(users)

    @staticmethod
    def hash_password(password: str) -> str:
        return hashlib.sha256(password.encode()).hexdigest()

    def authenticate(self, user: str, password: str) -> None:
        want = self.users.get(user)
        if want is None or want != self.hash_password(password):
            raise AuthenticationError(f"invalid credentials for {user}")


# -- authorization -----------------------------------------------------------


class AccessControl:
    def check_can_execute_query(self, user: str) -> None:
        pass

    def check_can_select(self, user: str, catalog: str,
                         table: str) -> None:
        pass

    def check_can_write(self, user: str, catalog: str,
                        table: str) -> None:
        pass


class AllowAllAccessControl(AccessControl):
    pass


@dataclasses.dataclass
class AccessRule:
    """First matching rule wins (FileBasedSystemAccessControl rules)."""

    user_pattern: str = ".*"
    catalog_pattern: str = ".*"
    table_pattern: str = ".*"
    allow: bool = True
    write: bool = True  # whether the rule also allows writes

    def matches(self, user: str, catalog: str, table: str) -> bool:
        return (re.fullmatch(self.user_pattern, user) is not None
                and re.fullmatch(self.catalog_pattern, catalog)
                is not None
                and re.fullmatch(self.table_pattern, table) is not None)


class RuleBasedAccessControl(AccessControl):
    def __init__(self, rules: list[AccessRule]):
        self.rules = list(rules)

    def _check(self, user: str, catalog: str, table: str,
               write: bool) -> None:
        for r in self.rules:
            if r.matches(user, catalog, table):
                if not r.allow or (write and not r.write):
                    break
                return
        kind = "write to" if write else "select from"
        raise AccessDeniedError(
            f"user {user} cannot {kind} {catalog}.{table}")

    def check_can_select(self, user, catalog, table):
        self._check(user, catalog, table, False)

    def check_can_write(self, user, catalog, table):
        self._check(user, catalog, table, True)
