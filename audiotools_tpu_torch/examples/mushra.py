"""MUSHRA listening-test app over the port's ``preference`` module.

Counterpart of the JAX package's ``examples/mushra.py``, flag for flag.
Layout on disk: ``folder/<condition>/<sample>.wav`` with matching sample
names across condition subfolders; optional ``<sample>.txt`` transcripts.

    python -m audiotools_tpu_torch.examples.mushra --folder audio/ --conditions a b c

(needs ``gradio``).
"""
import argparse
import string
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from .. import preference as pr


@dataclass
class Config:
    folder: str = None
    save_path: str = "results.csv"
    conditions: List[str] = field(default_factory=list)
    reference: str = None
    seed: int = 0
    share: bool = False
    n_samples: int = 10


def get_text(wav_file: str):
    txt_file = Path(wav_file).with_suffix(".txt")
    txt = txt_file.read_text() if txt_file.exists() else ""
    return f"""<div style="text-align:center;font-size:large;">{txt}</div>"""


def main(config: Config):
    import gradio as gr

    with gr.Blocks() as app:
        save_path = config.save_path
        samples = gr.State(pr.Samples(config.folder, n_samples=config.n_samples))

        reference = config.reference
        conditions = config.conditions

        player = pr.Player(app)
        player.create()
        if reference is not None:
            player.add("Play Reference")

        user = pr.create_tracker(app)
        ratings = []

        with gr.Row():
            txt = gr.HTML("")

        with gr.Row():
            gr.Button("Rate audio quality", interactive=False)
            with gr.Column(scale=8):
                gr.HTML(pr.slider_mushra)

        for i in range(len(conditions)):
            with gr.Row():
                x = string.ascii_uppercase[i]
                player.add(f"Play {x}")
                with gr.Column(scale=9):
                    ratings.append(gr.Slider(value=50, interactive=True))

        def build(user, samples, *ratings):
            # skip the samples this user has already rated
            samples.filter_completed(user, save_path)

            # write the last answer's results
            if samples.current > 0:
                start_idx = 1 if reference is not None else 0
                name = samples.names[samples.current - 1]
                result = {"sample": name, "user": user}
                for k, r in zip(samples.order[start_idx:], ratings):
                    result[k] = r
                pr.save_result(result, save_path)

            updates, done, pbar = samples.get_next_sample(reference, conditions)
            # once every sample is rated the updates carry no "value"
            wav_file = updates[0].get("value") if updates else None
            txt_update = gr.update(value=get_text(wav_file) if wav_file else "")

            return (
                updates
                + [gr.update(value=50) for _ in ratings]
                + [done, samples, pbar, txt_update]
            )

        progress = gr.HTML()
        begin = gr.Button("Submit", elem_id="start-survey")
        begin.click(
            fn=build,
            inputs=[user, samples] + ratings,
            outputs=player.to_list() + ratings + [begin, samples, progress, txt],
        ).then(None, _js=pr.reset_player)

        app.launch(share=config.share)


def parse_args(argv=None) -> Config:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--folder", required=True)
    parser.add_argument("--save_path", default="results.csv")
    parser.add_argument("--conditions", nargs="+", required=True)
    parser.add_argument("--reference", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--n_samples", type=int, default=10)
    return Config(**vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main(parse_args())
