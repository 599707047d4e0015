"""Helpers for holding the port against the JAX reference."""
