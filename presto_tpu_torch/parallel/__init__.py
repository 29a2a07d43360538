"""Distributed execution of one query over a shard group: the port of
``presto_tpu/parallel/executor.py`` and ``parallel/exchange.py``. The
collectives go through a :class:`~presto_tpu_torch.parallel.group.ShardGroup`
(every shard in one process, or one shard per ``torch.distributed``
rank)."""
