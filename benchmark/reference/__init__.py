"""The plain reference: a path tracer in PyTorch, independent of the
program under test, and the scene tables the configurations' recipes
build."""
