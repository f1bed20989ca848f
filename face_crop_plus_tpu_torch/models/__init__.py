"""The networks of the port."""
