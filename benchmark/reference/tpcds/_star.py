"""Lookups shared by the TPC-DS references: a store_sales row's
dimension attributes through its surrogate keys."""


def dim(db, table: str, key: str, column: str, fk):
    """``column`` of dimension ``table`` at each foreign key ``fk``."""
    return db.dense(table, key, column)[fk.long()]


def ok(db, table: str, key: str, rows, fk):
    """Which foreign keys ``fk`` name a dimension row in mask ``rows``."""
    return db.dense(table, key, rows=rows)[fk.long()]


def dates(db, fk, **want):
    """Which sold-date keys fall on dates whose columns equal ``want``
    (d_year=2000, d_moy=11, ...)."""
    rows = None
    for column, value in want.items():
        hit = db.col("date_dim", column) == value
        rows = hit if rows is None else rows & hit
    return ok(db, "date_dim", "d_date_sk", rows, fk)


def items(db, fk, **want):
    rows = None
    for column, value in want.items():
        hit = db.col("item", column) == value
        rows = hit if rows is None else rows & hit
    return ok(db, "item", "i_item_sk", rows, fk)


def demographics(db, fk, gender: str, marital: str, education: str):
    rows = (db.where("customer_demographics", "cd_gender",
                     lambda s: s == gender)
            & db.where("customer_demographics", "cd_marital_status",
                       lambda s: s == marital)
            & db.where("customer_demographics", "cd_education_status",
                       lambda s: s == education))
    return ok(db, "customer_demographics", "cd_demo_sk", rows, fk)
