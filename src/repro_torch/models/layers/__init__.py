"""Model layers (port of ``repro.models.layers``: the dense path)."""
