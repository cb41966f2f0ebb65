"""Helpers of the port: the JSONC config reader and the card's timer."""
