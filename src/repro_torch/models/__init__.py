"""Models of the port: the EGNN edge wiring and FastEGNN."""
