"""Pipeline and solver of the port."""
