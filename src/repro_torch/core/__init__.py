"""Graph containers, MLPs, the edge pathway and virtual nodes."""
