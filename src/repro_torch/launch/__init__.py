"""Entry points of the port: the trainer CLI (``launch/train.py``), the
elastic fleet (``launch/elastic.py``) and the rank processes' meshes and
launcher (``launch/mesh.py``).  The reference's sharding, planner,
dry-run, exchange and lint launchers are later slices."""
