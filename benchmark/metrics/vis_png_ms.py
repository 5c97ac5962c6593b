"""`vis_png_ms`: the mean host time of a frame's PNG (the program's `vis.png`
span: the uint8 conversion, the encode and the write of `vis/<n>.png`) begun
in the window. Trainer loop only."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "vis.png")
