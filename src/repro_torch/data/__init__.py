"""Data, after ``repro.data``: the synthetic LM token stream.  ``batch_specs``
(the dry run's shape stand-ins) comes with the dry-run slice (ROADMAP Queue
A item A11g)."""

from repro_torch.data.synthetic import SyntheticLMStream  # noqa: F401
