"""Data parallelism across processes (:mod:`.mesh`)."""
