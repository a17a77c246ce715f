"""Keyframes, relocalization and the loop-closing pose graph."""
