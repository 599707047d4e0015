"""Training substrate (port of ``repro.train``, in part): the
checkpoint format."""
