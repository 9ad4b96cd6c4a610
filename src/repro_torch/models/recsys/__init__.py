"""Recommendation models."""
