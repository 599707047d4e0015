"""Population-scale state (port of ``repro.fl.scale``, in part).

Only :mod:`~repro_torch.fl.scale.state_store` is here so far, for the
engines' checkpoint blobs; the population specs, the JSONL history sink
and the sharded scheduler wait for ROADMAP item 9.
"""
