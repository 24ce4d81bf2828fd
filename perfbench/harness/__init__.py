"""The yardstick: cells resolved by name, the loops that drive the
program, the traced span, the arithmetic of the readers, and the check."""
