"""Partitioned execution plans and their placement over executors
(``partition``)."""
