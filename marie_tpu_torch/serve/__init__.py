"""The serving plane of the port (HTTP on the standard library)."""
