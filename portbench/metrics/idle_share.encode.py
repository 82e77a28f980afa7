"""`idle_share.query`'s reading for the encode cell, which moves
`docs_per_s`: the share of the traced window with no operation on the card."""
from portbench.lib.cell import load_module

read = load_module("metrics", "idle_share.query").read
