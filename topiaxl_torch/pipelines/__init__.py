"""Inference pipelines."""
