"""PyTorch / CUDA twins of the repo's examples (examples/), run on the card
unless ``--device cpu`` asks for the CPU."""
