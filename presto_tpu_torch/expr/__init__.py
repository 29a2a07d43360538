"""Row-expression IR (``ir``), its tensor compiler (``compile``) and
the aggregate registry (``aggmeta`` metadata, ``aggregates`` bodies)."""
