"""Launch layer of the port: the serving driver (``serve``) and the data
axis of the sharded scheduler (``mesh``)."""
