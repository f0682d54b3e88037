"""Partitioned execution plans and their placement over executors
(``partition``), lock-step collectives (``lockstep``) and the H100's
roofline terms (``roofline``)."""
