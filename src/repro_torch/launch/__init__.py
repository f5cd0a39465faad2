"""Launch helpers of the port: device meshes over ``torch.distributed``.

Counterpart of ``repro.launch``.  Only ``mesh.py`` is ported so far; the
meta-device dry run (``dryrun.py``) and the profiler analogue of
``hlo_analysis.py`` are still to come (ROADMAP Queue 1).
"""
