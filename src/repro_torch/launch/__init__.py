"""Entry points of the port: the trainer CLI (``launch/train.py``), the
elastic fleet (``launch/elastic.py``), the rank processes' meshes and
launcher (``launch/mesh.py``) and the linter CLI (``launch/lint.py``).
The reference's sharding, planner, dry-run and exchange launchers are
later slices."""
