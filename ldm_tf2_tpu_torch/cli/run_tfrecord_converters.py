"""TFRecord conversion CLI of the port (counterpart of
``ldm_tf2_tpu.cli.run_tfrecord_converters``, same flags):

    python -m ldm_tf2_tpu_torch.cli.run_tfrecord_converters \\
        --images_glob '/data/celebahq/*.jpg' --images_out /data/tfrecords
    python -m ldm_tf2_tpu_torch.cli.run_tfrecord_converters \\
        --coco_root /data/coco --coco_part train2017 \\
        --coco_annotations captions_train2017.json \\
        --captions_out /data/tfrecords_captions --vocab_dir bert_model

Images go to the AE trainer's ``autoencoder_training.root_path``, image
and caption records to the LDM trainer's ``ldm_training.root_path``.
"""

from __future__ import annotations

import argparse
import glob


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.data.dataset import (
        convert_coco_captions_to_tfrecord, convert_images_to_tfrecord,
    )
    from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--images_glob", help="glob of images to convert")
    parser.add_argument("--images_out", help="output dir for image TFRecords")
    parser.add_argument("--image_shards", type=int, default=100)
    parser.add_argument("--coco_root", help="COCO root directory")
    parser.add_argument("--coco_part", default="train2017",
                        help="COCO split directory name")
    parser.add_argument("--coco_annotations", default="captions_train2017.json",
                        help="annotation file name under <coco_root>/annotations")
    parser.add_argument("--captions_out", help="output dir for caption TFRecords")
    parser.add_argument("--caption_shards", type=int, default=20)
    parser.add_argument("--vocab_dir", default="bert_model",
                        help="directory of the BERT vocab.txt")
    parser.add_argument("--max_length", type=int, default=77,
                        help="caption token length (truncated and padded)")
    args = parser.parse_args(argv)

    did_something = False
    if args.images_glob and args.images_out:
        filenames = sorted(glob.glob(args.images_glob))
        print(f"[INFO] Converting {len(filenames)} images -> {args.images_out}")
        convert_images_to_tfrecord(filenames, args.images_out, args.image_shards)
        did_something = True
    if args.coco_root and args.captions_out:
        print(f"[INFO] Converting COCO captions -> {args.captions_out}")
        convert_coco_captions_to_tfrecord(
            args.coco_root, args.coco_part, args.coco_annotations,
            load_tokenizer(args.vocab_dir), args.captions_out,
            args.max_length, args.caption_shards,
        )
        did_something = True
    if not did_something:
        parser.error("provide --images_glob/--images_out and/or "
                     "--coco_root/--captions_out")


if __name__ == "__main__":
    main()
