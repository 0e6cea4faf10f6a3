"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of a model and of its kernels' calls, counted from layer shapes."""
