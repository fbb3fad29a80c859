"""Serving (port of ``repro.serving``: the paged-KV engine, no mesh)."""
