"""Per circuit kind: ``shape(cfg) -> (m0, R1CS constraints)`` and
``publics(cfg, statement) -> public inputs`` (without the leading 1)."""
