"""`vis_panels_ms`: the mean host time of a frame's TensorBoard image panels
(the program's `vis.panels` span, one a frame: each panel's encode and
event, and the mask and edge panels' forward) begun in the window. Trainer
loop only."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "vis.panels")
