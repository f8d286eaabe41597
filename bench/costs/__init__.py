"""Operations and bytes from shapes alone: the yardstick of the benchmark's
roofline and utilisation metrics, kept apart from the program so that the
same work is reckoned whatever implements it."""
