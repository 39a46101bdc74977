"""Launch layer, after ``repro.launch``: the serving entry point (``serve.py``).
The rest of the JAX package's launch layer (meshes, the dry-run compiler,
the training loop) waits for its ROADMAP items (Queue A item 11), apart from
``memmodel.py``, which comes with the benchmark harness (item A6)."""
