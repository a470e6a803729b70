"""Train the unified WordPiece text tokenizer, PyTorch port of
fourm_tpu/cli/train_text_tokenizer.py (reference
train_wordpiece_tokenizer.py:1-70): a 30k vocab with 100 sentinel tokens,
4 x 1000 coordinate tokens and the COCO object-class tokens, trained by the
port's own WordPiece trainer (utils/text_tokenizer.py; no `tokenizers`
package) on the host. Run: python -m fourm_torch.cli.train_text_tokenizer
--files corpus.txt [--vocab_size 30000] [--output tokenizer.json]."""

from __future__ import annotations

import argparse


def get_parser():
    p = argparse.ArgumentParser("WordPiece tokenizer training")
    p.add_argument("--files", nargs="+", required=True, help="text corpus files")
    p.add_argument("--vocab_size", type=int, default=30_000)
    p.add_argument("--num_sentinels", type=int, default=100)
    p.add_argument("--coord_bins", type=int, default=1000)
    p.add_argument("--object_classes", default="coco", choices=["coco", "none"])
    p.add_argument("--min_frequency", type=int, default=0)
    p.add_argument("--output", default="text_tokenizer_4m_wordpiece.json")
    return p


def main(args=None):
    """Train and save; returns the trained tokenizer (utils/text_tokenizer.py:
    WordPieceTokenizer)."""
    from ..utils.text_tokenizer import (generate_coord_tokens, generate_object_class_tokens,
                                        generate_sentinel_tokens,
                                        train_unified_wordpiece_tokenizer)

    args = get_parser().parse_args(args)
    tok = train_unified_wordpiece_tokenizer(
        args.files,
        vocab_size=args.vocab_size,
        sentinel_tokens=generate_sentinel_tokens(num=args.num_sentinels),
        coord_tokens=generate_coord_tokens(bins=args.coord_bins),
        object_class_tokens=(
            generate_object_class_tokens() if args.object_classes == "coco" else None),
        min_frequency=args.min_frequency,
    )
    tok.save(args.output)
    print(f"saved tokenizer to {args.output} (vocab {tok.get_vocab_size()})")
    return tok


if __name__ == "__main__":
    main()
