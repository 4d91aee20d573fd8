"""Human annotation tool for cross-scene pixel correspondences.

Port of :mod:`pdc_tpu.apps.annotate_correspondences` (:27-103), a rebuild of
the reference's ``simple_pixel_correspondence_labeler/
annotate_correspondences.py:135-165``: click matching pixels in two images
drawn from different scenes of the same object; 's' saves to
``new_annotated_pairs.yaml`` in the format the evaluator reads (s = save
pair, n = next pair, q = quit).

The YAML format (reference :119-133), written with the port's emitter:
    - image_a: {scene_name, image_idx, pixels: [{u, v}, ...]}
      image_b: {scene_name, image_idx, pixels: [{u, v}, ...]}
"""

from __future__ import annotations

from typing import List

from pdc_tpu_torch.utils.yaml_io import save_yaml

LABEL_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255),
    (255, 255, 0), (255, 0, 255), (0, 255, 255),
]


def _side(scene, idx, pixels):
    return {"scene_name": scene, "image_idx": int(idx),
            "pixels": [{"u": int(u), "v": int(v)} for u, v in pixels]}


def make_annotation_entry(scene_a, idx_a, pixels_a, scene_b, idx_b, pixels_b):
    """One annotated pair in the reference's on-disk format."""
    return {"image_a": _side(scene_a, idx_a, pixels_a),
            "image_b": _side(scene_b, idx_b, pixels_b)}


def save_annotations(annotations: List[dict], filename: str = "new_annotated_pairs.yaml"):
    save_yaml(annotations, filename, nested=True)


class AnnotationApp:  # pragma: no cover - interactive cv2 UI
    def __init__(self, dataset, output_file: str = "new_annotated_pairs.yaml"):
        self._dataset = dataset
        self._output_file = output_file
        self._annotations: List[dict] = []

    def run(self):
        import cv2

        from pdc_tpu_torch.losses.composer import MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE
        from pdc_tpu_torch.utils.visualization import draw_reticle

        pair = self._dataset.sample_pair(MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE)
        clicks = {"a": [], "b": []}

        def redraw():
            img_a = cv2.cvtColor(pair.rgb_a, cv2.COLOR_RGB2BGR)
            img_b = cv2.cvtColor(pair.rgb_b, cv2.COLOR_RGB2BGR)
            for i, (u, v) in enumerate(clicks["a"]):
                draw_reticle(img_a, u, v, LABEL_COLORS[i % len(LABEL_COLORS)])
            for i, (u, v) in enumerate(clicks["b"]):
                draw_reticle(img_b, u, v, LABEL_COLORS[i % len(LABEL_COLORS)])
            cv2.imshow("image_a", img_a)
            cv2.imshow("image_b", img_b)

        def on_click(side):
            def cb(event, u, v, flags, param):
                if event == cv2.EVENT_LBUTTONDOWN:
                    clicks[side].append((u, v))
                    redraw()
            return cb

        cv2.namedWindow("image_a")
        cv2.namedWindow("image_b")
        cv2.setMouseCallback("image_a", on_click("a"))
        cv2.setMouseCallback("image_b", on_click("b"))
        redraw()

        while True:
            k = cv2.waitKey(20) & 0xFF
            if k == ord("q"):
                break
            if k == ord("s"):
                n = min(len(clicks["a"]), len(clicks["b"]))
                if n:
                    self._annotations.append(make_annotation_entry(
                        pair.metadata["scene_name_a"], pair.metadata["image_a_idx"],
                        clicks["a"][:n],
                        pair.metadata["scene_name_b"], pair.metadata["image_b_idx"],
                        clicks["b"][:n],
                    ))
                    save_annotations(self._annotations, self._output_file)
            if k == ord("n"):
                pair = self._dataset.sample_pair(MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE)
                clicks = {"a": [], "b": []}
                redraw()
        cv2.destroyAllWindows()
