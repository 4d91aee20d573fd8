"""Frozen arithmetic of the benchmark: operations and bytes computed from
shapes alone, and the card's data-sheet peaks. Nothing here is computed by
the program under test."""
