"""`vis_render_ms`: the mean host time of a frame's render (the program's
`vis.render` span: the full-canvas forward and its copy to the host) begun
in the window. Trainer loop only: the steady loop draws no frame."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "vis.render")
