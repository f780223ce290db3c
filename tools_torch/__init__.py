"""PyTorch / CUDA twins of the repo's frame bench tools (tools/), run on the card
unless ``--cpu`` asks for the CPU."""
