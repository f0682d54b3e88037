"""Async, atomic, elastic checkpointing of the train state
(``manager``)."""
