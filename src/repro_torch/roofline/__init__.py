"""Roofline arithmetic for the card (port of ``repro.roofline``)."""
