"""The benchmark's yardstick, frozen here so that no change to the program
can move it: the kernels' work formulas, the model-flop formulas and the
table of the cards' peaks."""
