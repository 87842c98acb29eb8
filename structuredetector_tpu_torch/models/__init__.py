"""The port's SDNet and its weights."""
