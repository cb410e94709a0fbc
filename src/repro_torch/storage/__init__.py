"""Paged table storage and its device views."""
