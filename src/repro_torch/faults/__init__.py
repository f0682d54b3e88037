"""Fault classes (``errors``): the part of the reference's taxonomy
that the port raises so far."""
