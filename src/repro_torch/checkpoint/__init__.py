"""Checkpoints of the port (:mod:`.ckpt`), interchangeable with
``repro.checkpoint``'s."""
