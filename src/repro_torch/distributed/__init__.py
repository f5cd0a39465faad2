"""Serving and training on a device mesh over ``torch.distributed``.

Counterpart of ``repro.distributed``: the sharding rules and the
sharded training state (``sharding.py``), the SP decode, vocab-parallel
embed and prefill-write collectives and the training collectives
(``collectives.py``), elastic checkpoint resharding (``elastic.py``) and
GPipe pipeline parallelism (``pipeline.py``).  ``parallel.py`` has no
counterpart file: it does eagerly what GSPMD does for the reference's
sharded train step (FSDP gathers, tensor parallel, the gradients'
reductions).  ``probe.py`` reports which collectives gloo runs on CUDA
tensors.  One process is one mesh member; each runs the same entry point
on its own shards, as the body of the reference's ``shard_map`` does,
and the collectives run over the process group of the named mesh dims.

The reference's ``_compat.py`` has no counterpart: it bridges JAX
releases (``jax.shard_map`` vs ``jax.experimental.shard_map``, ``pcast``
varying-axis annotations), none of which exist here.
"""
