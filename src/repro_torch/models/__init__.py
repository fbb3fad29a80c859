"""Model stack (port of ``repro.models``: the dense decoder)."""
