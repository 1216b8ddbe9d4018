"""Every token of every batch completed in the window, prompt and served
tokens, over the host time from the first batch's start to the last
batch's last token."""
UNIT, RUN, SOURCE = "tokens/s", "plain", "host_clock"


def read(run):
    t = run.traffic
    tokens = len(run.batches) * t["batch"] * (t["prompt_len"] + t["new_tokens"])
    return tokens / run.window_s
