"""Keypoint tables and eval input preparation."""
