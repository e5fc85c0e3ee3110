"""Graph building (numpy on the host, ``cell_list`` on the device), the
fluid scene generator, the batch loader and the shared worker pool."""
