"""Models of the port: the registry (``models.registry``) and its ten
models — linear and MPNN (``baselines``), EGNN, RF, SchNet, TFN, FastEGNN
and the Sec. V plug-ins (``plugin``) on RF, SchNet and TFN."""
