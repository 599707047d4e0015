"""Launch layer of the port: the training CLI (``train``) and its step
functions (``steps``), the serving CLI (``serve``) and the data axis
of the sharded scheduler (``mesh``)."""
