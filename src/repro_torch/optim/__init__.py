"""The optimizer (``adamw``) and the cross-pod gradient compression
(``compress``) of the training step."""
