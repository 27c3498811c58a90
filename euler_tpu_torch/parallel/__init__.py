"""The sharded graph plane over torch.distributed: the mesh of ranks
(``mesh``), the differentiable collectives and their byte accounting
(``comms``), the sharded store and its verbs (``sharded``), the sharded
train step and apply (``train``) and the process group, per-rank graph
loading and liveness probe of a many-process job (``distributed``)."""
