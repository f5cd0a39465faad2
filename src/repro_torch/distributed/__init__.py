"""Serving on a device mesh over ``torch.distributed``.

Counterpart of ``repro.distributed``: the sharding rules
(``sharding.py``), the SP decode, vocab-parallel embed and prefill-write
collectives (``collectives.py``) and elastic checkpoint resharding
(``elastic.py``).  One process is one mesh member; each runs the same
entry point on its own shards, as the body of the reference's
``shard_map`` does, and the combines go through ``all_reduce`` over the
process group of the named mesh dims.

The reference's ``_compat.py`` has no counterpart: it bridges JAX
releases (``jax.shard_map`` vs ``jax.experimental.shard_map``, ``pcast``
varying-axis annotations), none of which exist here.  ``pipeline.py``
belongs to the training slice that is still to come (ROADMAP Queue 1).
"""
