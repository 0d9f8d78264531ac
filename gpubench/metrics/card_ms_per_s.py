"""``card_ms_per_s.<config>``: the milliseconds the card is busy with
the receiver per signal second, over the whole window: the union of
every kernel, copy and set of the program (the generator's left out)
from the profiler's record of the card, over the signal seconds of the
blocks completed. What the receiver costs of the card, and where a card
is shared, what is left of it for other work."""
from gpubench.harness.readers import card_ms_per_s as read  # noqa: F401

CARD_CLOCK = True
