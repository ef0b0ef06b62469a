"""Serving: the slotted KV pool, lock-step generate and the continuous-batching engine."""
