"""fps: frames delivered inside the window (their last output topic
arrived before it closed, without an error) over the window's seconds."""


def read(run):
    n = sum(1 for f in run.frames if f.t_done is not None and not f.error
            and f.t_done <= run.t_end)
    return n / run.seconds
