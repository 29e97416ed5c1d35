"""Proximity capture: islands around the rig's markers and the capture
distances the falloff reads (component E)."""
