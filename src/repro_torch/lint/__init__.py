"""Host-side lock-order sanitizer of the port (``lockorder``)."""
