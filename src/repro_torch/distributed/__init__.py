"""Partitioned execution plans (``partition``); the device placement
helpers come with sharded execution."""
