"""File-format readers (the engine's analog of the reference's
lib/trino-parquet and lib/trino-orc readers)."""
