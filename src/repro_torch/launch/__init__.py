"""Launch layer, after ``repro.launch``: the serving entry point (``serve.py``)
and the trainer (``train.py``).  The rest of the JAX package's
launch layer waits for its ROADMAP items: meshes, sharding and elastic
re-meshing (Queue A item A11f), the dry-run compiler and ``steps.py``'s
jitted, sharded step plans (A11g), and ``memmodel.py``, which comes with the
benchmark harness (A6)."""
