"""Device ops of the port: decode, normalization, kernels."""
