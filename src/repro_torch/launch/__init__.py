"""Launchers (port of ``repro.launch``)."""
