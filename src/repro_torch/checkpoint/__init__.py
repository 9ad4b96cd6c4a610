"""Sharded async checkpoints (port of ``repro/checkpoint``)."""
