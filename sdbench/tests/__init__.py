"""CPU tests of the benchmark (card-only cases skip here with a reason)."""
