"""Several cards of one host (``mesh``)."""
