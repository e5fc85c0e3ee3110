"""Host-side graph building (numpy), the fluid scene generator and the
batch loader."""
