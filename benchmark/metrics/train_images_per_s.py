"""Images of all training steps completed in the window over its wall
time (the window ends in torch.cuda.synchronize())."""


def read(run):
    return run.loop.steps * run.batch / run.loop.window_s
