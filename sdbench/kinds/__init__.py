"""Per-cell drivers, one a traffic kind: `setup(ctx)`, `window(state, seconds, recorder)`, `check(state)`."""
