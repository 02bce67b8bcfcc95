"""The eval scripts that build the flagship (port of runs/eval/)."""
