"""What runs one window, by the traffic mix's ``kind``: each module
defines ``Cell(cfg, mix, seed, device)`` with ``warm``, ``window``,
``traced``, ``end_to_end`` and ``checks``."""


class Answers:
    """What a step put in the program's place returns (the control): it
    answers the comparison directly, ``at(rows)`` giving the compared
    value of each row as the cell's ``judged`` would read it from the
    program's output."""

    def __init__(self, at):
        self.at = at
