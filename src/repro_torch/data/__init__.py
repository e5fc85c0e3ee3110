"""Host-side graph building (numpy) and the fluid scene generator."""
