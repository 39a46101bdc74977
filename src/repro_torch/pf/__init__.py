"""The SIR particle filter on the paper's UNGM benchmark (paper §7)."""
