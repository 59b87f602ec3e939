"""Eval step and the serving predictor."""
