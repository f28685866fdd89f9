"""Entry points of the port: the trainer CLI (``launch/train.py``) and the
elastic fleet (``launch/elastic.py``).  The reference's mesh, sharding,
planner, dry-run, exchange and lint launchers are later slices."""
