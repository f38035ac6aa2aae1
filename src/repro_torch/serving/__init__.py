"""Serving: the batched greedy-decode engine of the LM framework."""
