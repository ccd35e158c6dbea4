"""Data parallelism over ``torch.distributed`` (``sharding.py``) and its
1-vs-N dry run (``python -m objgan_tpu_torch.parallel.dryrun N``)."""
