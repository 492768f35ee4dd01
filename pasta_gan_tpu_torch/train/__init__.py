"""Training: losses, VGG19 features, state, steps and the loop."""
