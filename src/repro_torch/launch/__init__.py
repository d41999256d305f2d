"""Entry points (port of ``src/repro/launch``): ``serve``, ``train`` (any
arch's train shape through ``steps.build_step``), ``dryrun`` and ``perf``
(the bundle dry run on the production meshes of ``mesh``),
``sketch_dryrun``; and the port's ``train_lm`` and ``gnn_sketch_sampling``,
the counterparts of ``examples/train_lm.py`` and
``examples/gnn_sketch_sampling.py``."""
