"""Host-side data handling of the port."""
