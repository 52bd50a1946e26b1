"""Applications on the port: the circuit IR, the nander console and its fused evaluator."""
