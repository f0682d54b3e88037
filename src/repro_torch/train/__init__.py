"""The training step (``step``): AdamW on an f32 master, gradient
accumulation, cross-pod gradient compression."""
