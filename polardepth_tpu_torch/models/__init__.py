"""Network modules of the port (channels-first inside, channels-last at
the network's inputs and outputs)."""
