"""Models: layers, HRNet, FAMIPose, and the weight bridge."""
