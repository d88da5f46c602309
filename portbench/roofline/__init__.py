"""Operations and bytes of the port's kernels and of a whole step, from
shapes alone, and the table of the card's peaks (``peaks.json``)."""
