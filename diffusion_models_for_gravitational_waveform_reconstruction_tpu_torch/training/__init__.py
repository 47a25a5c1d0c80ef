"""Training engine of the port."""
