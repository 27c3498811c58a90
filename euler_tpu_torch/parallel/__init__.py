"""The sharded graph plane over torch.distributed: the mesh of ranks
(``mesh``), the collectives and their byte accounting (``comms``), the
sharded store and its verbs (``sharded``) and the sharded apply
(``train``)."""
