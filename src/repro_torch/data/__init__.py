"""The paper's Table 1 suite, synthesized."""
