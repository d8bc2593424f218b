"""Several devices in one process (``mesh``)."""
