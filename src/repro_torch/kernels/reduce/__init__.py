"""Row reductions whose order depends on the row's length alone, for Hopper."""
