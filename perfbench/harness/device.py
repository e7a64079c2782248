"""The card's synchronisation points, with a host stand-in where the
drivers run on the CPU (the benchmark's CPU tests); ``run.py`` refuses to
run without a card, so a measured run always takes the card's."""
import torch


class _HostEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


def on_card() -> bool:
    return torch.cuda.is_available()


def synchronize():
    if on_card():
        torch.cuda.synchronize()


def event():
    """An event recorded on the current stream."""
    e = torch.cuda.Event() if on_card() else _HostEvent()
    e.record()
    return e


def device():
    return torch.device("cuda") if on_card() else torch.device("cpu")


def empty_cache():
    if on_card():
        torch.cuda.empty_cache()


def reset_peak():
    if on_card():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return int(torch.cuda.max_memory_allocated()) if on_card() else 0


def name() -> str:
    return torch.cuda.get_device_name(0) if on_card() else "cpu"
