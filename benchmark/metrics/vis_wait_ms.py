"""`vis_wait_ms`: the mean host time a frame's hand-off waits for the frame
before it to be written (the program's `vis.wait` span, one a frame: near 0
while the writer thread keeps up) begun in the window. Trainer loop only; a
program that writes its frames in line has no such span and reports nothing."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "vis.wait")
